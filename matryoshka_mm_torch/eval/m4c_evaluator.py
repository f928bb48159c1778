"""EvalAI-style answer normalization and accuracy evaluators
(reference: llava/eval/m4c_evaluator.py:1-334, itself the standard
M4C/EvalAI answer processor used by TextVQA / ST-VQA).

Includes the TextVQA 10-annotator consensus accuracy, STVQA exact accuracy,
ANLS (normalized Levenshtein), and TextCaps BLEU-4.
"""

from __future__ import annotations

import re
from typing import Dict, List


class EvalAIAnswerProcessor:
    """Lowercase, strip punctuation/articles, digit-map, contractions."""

    CONTRACTIONS = {
        "aint": "ain't", "arent": "aren't", "cant": "can't",
        "couldve": "could've", "couldnt": "couldn't",
        "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
        "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
        "hadnt": "hadn't", "hadnt've": "hadn't've", "hadn'tve": "hadn't've",
        "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
        "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
        "howd": "how'd", "howll": "how'll", "hows": "how's",
        "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
        "isnt": "isn't", "itd": "it'd", "itd've": "it'd've",
        "it'dve": "it'd've", "itll": "it'll", "let's": "let's",
        "maam": "ma'am", "mightnt": "mightn't", "mightnt've": "mightn't've",
        "mightn'tve": "mightn't've", "mightve": "might've",
        "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
        "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
        "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
        "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
        "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
        "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
        "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
        "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
        "somebodys": "somebody's", "someoned": "someone'd",
        "someoned've": "someone'd've", "someone'dve": "someone'd've",
        "someonell": "someone'll", "someones": "someone's",
        "somethingd": "something'd", "somethingd've": "something'd've",
        "something'dve": "something'd've", "somethingll": "something'll",
        "thats": "that's", "thered": "there'd", "thered've": "there'd've",
        "there'dve": "there'd've", "therere": "there're",
        "theres": "there's", "theyd": "they'd", "theyd've": "they'd've",
        "they'dve": "they'd've", "theyll": "they'll", "theyre": "they're",
        "theyve": "they've", "twas": "'twas", "wasnt": "wasn't",
        "wed've": "we'd've", "we'dve": "we'd've", "weve": "we've",
        "werent": "weren't", "whatll": "what'll", "whatre": "what're",
        "whats": "what's", "whatve": "what've", "whens": "when's",
        "whered": "where'd", "wheres": "where's", "whereve": "where've",
        "whod": "who'd", "whod've": "who'd've", "who'dve": "who'd've",
        "wholl": "who'll", "whos": "who's", "whove": "who've",
        "whyll": "why'll", "whyre": "why're", "whys": "why's",
        "wont": "won't", "wouldve": "would've", "wouldnt": "wouldn't",
        "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
        "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
        "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
        "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
        "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
        "youve": "you've",
    }

    NUMBER_MAP = {
        "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
        "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
        "nine": "9", "ten": "10",
    }
    ARTICLES = ["a", "an", "the"]
    PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
    COMMA_STRIP = re.compile(r"(?<=\d)(\,)+(?=\d)")
    PUNCT = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\",
             "_", "-", ">", "<", "@", "`", ",", "?", "!"]

    def word_tokenize(self, word: str) -> str:
        word = word.lower()
        word = word.replace(",", "").replace("?", "").replace("'s", " 's")
        return word.strip()

    def process_punctuation(self, in_text: str) -> str:
        out_text = in_text
        for p in self.PUNCT:
            if (p + " " in in_text or " " + p in in_text) or (
                re.search(self.COMMA_STRIP, in_text) is not None
            ):
                out_text = out_text.replace(p, "")
            else:
                out_text = out_text.replace(p, " ")
        out_text = self.PERIOD_STRIP.sub("", out_text, re.UNICODE)
        return out_text

    def process_digit_article(self, in_text: str) -> str:
        out_text = []
        for word in in_text.lower().split():
            word = self.NUMBER_MAP.setdefault(word, word)
            if word not in self.ARTICLES:
                out_text.append(word)
        for i, word in enumerate(out_text):
            if word in self.CONTRACTIONS:
                out_text[i] = self.CONTRACTIONS[word]
        return " ".join(out_text)

    def __call__(self, item: str) -> str:
        item = self.word_tokenize(item)
        item = item.replace("\n", " ").replace("\t", " ").strip()
        item = self.process_punctuation(item)
        item = self.process_digit_article(item)
        return item


class TextVQAAccuracyEvaluator:
    """10-annotator consensus accuracy (min(matches/3, 1) averaged over
    leave-one-out subsets)."""

    def __init__(self):
        self.answer_processor = EvalAIAnswerProcessor()

    def _compute_answer_scores(self, raw_answers: List[str]) -> Dict[str, float]:
        answers = [self.answer_processor(a) for a in raw_answers]
        assert len(answers) == 10
        gt_answers = list(enumerate(answers))
        unique_answers = set(answers)
        unique_answer_scores = {}
        for unique_answer in unique_answers:
            accs = []
            for gt_answer in gt_answers:
                other_answers = [item for item in gt_answers if item != gt_answer]
                matching_answers = [item for item in other_answers
                                    if item[1] == unique_answer]
                acc = min(1, float(len(matching_answers)) / 3)
                accs.append(acc)
            unique_answer_scores[unique_answer] = sum(accs) / len(accs)
        return unique_answer_scores

    def eval_pred_list(self, pred_list: List[Dict]) -> float:
        pred_scores = []
        for entry in pred_list:
            pred_answer = self.answer_processor(entry["pred_answer"])
            unique_answer_scores = self._compute_answer_scores(entry["gt_answers"])
            pred_scores.append(unique_answer_scores.get(pred_answer, 0.0))
        return sum(pred_scores) / len(pred_scores)


class STVQAAccuracyEvaluator:
    def __init__(self):
        self.answer_processor = EvalAIAnswerProcessor()

    def eval_pred_list(self, pred_list: List[Dict]) -> float:
        pred_scores = []
        for entry in pred_list:
            pred_answer = self.answer_processor(entry["pred_answer"])
            gts = [self.answer_processor(a) for a in entry["gt_answers"]]
            pred_scores.append(1.0 if pred_answer in gts else 0.0)
        return sum(pred_scores) / len(pred_scores)


def _levenshtein(s1: str, s2: str) -> int:
    if len(s1) > len(s2):
        s1, s2 = s2, s1
    distances = range(len(s1) + 1)
    for i2, c2 in enumerate(s2):
        new = [i2 + 1]
        for i1, c1 in enumerate(s1):
            if c1 == c2:
                new.append(distances[i1])
            else:
                new.append(1 + min(distances[i1], distances[i1 + 1], new[-1]))
        distances = new
    return distances[-1]


class STVQAANLSEvaluator:
    """Average Normalized Levenshtein Similarity (threshold 0.5)."""

    def get_anls(self, s1: str, s2: str) -> float:
        s1, s2 = s1.lower().strip(), s2.lower().strip()
        iou = 1 - _levenshtein(s1, s2) / max(len(s1), len(s2), 1)
        return iou if iou >= 0.5 else 0.0

    def eval_pred_list(self, pred_list: List[Dict]) -> float:
        pred_scores = []
        for entry in pred_list:
            anls = max(self.get_anls(entry["pred_answer"], gt)
                       for gt in entry["gt_answers"])
            pred_scores.append(anls)
        return sum(pred_scores) / len(pred_scores)


class TextCapsBleu4Evaluator:
    """Corpus BLEU-4 of predicted captions vs references (simple
    implementation; reference uses pycocoevalcap's Bleu)."""

    def eval_pred_list(self, pred_list: List[Dict]) -> float:
        import collections
        import math

        def ngrams(tokens, n):
            return collections.Counter(
                tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))

        log_precisions = []
        for n in range(1, 5):
            match, total = 0, 0
            for entry in pred_list:
                hyp = entry["pred_answer"].lower().split()
                refs = [r.lower().split() for r in entry["gt_answers"]]
                hyp_ng = ngrams(hyp, n)
                max_ref = collections.Counter()
                for r in refs:
                    for g, c in ngrams(r, n).items():
                        max_ref[g] = max(max_ref[g], c)
                match += sum(min(c, max_ref[g]) for g, c in hyp_ng.items())
                total += max(sum(hyp_ng.values()), 1)
            log_precisions.append(math.log(max(match, 1e-12) / total))
        hyp_len = sum(len(e["pred_answer"].split()) for e in pred_list)
        ref_len = sum(min((abs(len(r.split()) - len(e["pred_answer"].split())),
                           len(r.split()))
                          for r in e["gt_answers"])[1] for e in pred_list)
        bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
        return bp * math.exp(sum(log_precisions) / 4)

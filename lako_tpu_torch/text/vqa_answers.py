"""VQA-standard answer preprocessing and soft-score targets: a copy of
lako_tpu/text/vqa_answers.py, pinned to the original by
tests/test_torch_dataprep.py.

Contraction restoration, number-word → digit mapping, article removal, the
VQA punctuation rules, and the 0/0.3/0.6/0.9/1.0 occurrence-count soft
score. These feed the answer vocabulary (``ans2label``) and the per-question
soft labels that become reader targets.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't", "hadnt": "hadn't",
    "hadnt've": "hadn't've", "hadn'tve": "hadn't've", "hasnt": "hasn't",
    "havent": "haven't", "hed": "he'd", "hed've": "he'd've", "he'dve": "he'd've",
    "hes": "he's", "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've", "it'dve": "it'd've",
    "itll": "it'll", "let's": "let's", "maam": "ma'am", "mightnt": "mightn't",
    "mightnt've": "mightn't've", "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't", "notve": "not've",
    "oclock": "o'clock", "oughtnt": "oughtn't", "ow's'at": "'ow's'at",
    "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at", "shant": "shan't",
    "shed've": "she'd've", "she'dve": "she'd've", "she's": "she's",
    "shouldve": "should've", "shouldnt": "shouldn't", "shouldnt've": "shouldn't've",
    "shouldn'tve": "shouldn't've", "somebody'd": "somebodyd",
    "somebodyd've": "somebody'd've", "somebody'dve": "somebody'd've",
    "somebodyll": "somebody'll", "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's", "somethingd": "something'd",
    "somethingd've": "something'd've", "something'dve": "something'd've",
    "somethingll": "something'll", "thats": "that's", "thered": "there'd",
    "thered've": "there'd've", "there'dve": "there'd've", "therere": "there're",
    "theres": "there's", "theyd": "they'd", "theyd've": "they'd've",
    "they'dve": "they'd've", "theyll": "they'll", "theyre": "they're",
    "theyve": "they've", "twas": "'twas", "wasnt": "wasn't", "wed've": "we'd've",
    "we'dve": "we'd've", "weve": "we've", "werent": "weren't", "whatll": "what'll",
    "whatre": "what're", "whats": "what's", "whatve": "what've", "whens": "when's",
    "whered": "where'd", "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll", "whos": "who's",
    "whove": "who've", "whyll": "why'll", "whyre": "why're", "whys": "why's",
    "wont": "won't", "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've", "yall": "y'all",
    "yall'll": "y'all'll", "y'allll": "y'all'll", "yall'd've": "y'all'd've",
    "y'alld've": "y'all'd've", "y'all'dve": "y'all'd've", "youd": "you'd",
    "youd've": "you'd've", "you'dve": "you'd've", "youll": "you'll",
    "youre": "you're", "youve": "you've",
}

MANUAL_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3", "four": "4",
    "five": "5", "six": "6", "seven": "7", "eight": "8", "nine": "9", "ten": "10",
}

ARTICLES = ("a", "an", "the")
# VQA eval regexes (note: the original's `(?!<=\d)` is a typo'd lookahead on a
# literal "<=\d"; it matches any position, so the net effect is "strip periods not
# followed by a digit" — preserved for parity).
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(\,)(\d)")
PUNCT = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_", "-",
         ">", "<", "@", "`", ",", "?", "!"]


def process_punctuation(in_text: str) -> str:
    out_text = in_text
    for p in PUNCT:
        if (p + " " in in_text or " " + p in in_text) or _COMMA_STRIP.search(in_text):
            out_text = out_text.replace(p, "")
        else:
            out_text = out_text.replace(p, " ")
    return _PERIOD_STRIP.sub("", out_text)


def process_digit_article(in_text: str) -> str:
    out = []
    for word in in_text.lower().split():
        word = MANUAL_MAP.get(word, word)
        if word not in ARTICLES:
            out.append(word)
    for i, word in enumerate(out):
        if word in CONTRACTIONS:
            out[i] = CONTRACTIONS[word]
    return " ".join(out)


def preprocess_answer(answer: str) -> str:
    answer = process_digit_article(process_punctuation(answer))
    return answer.replace(",", "")


def get_score(occurences: int) -> float:
    """VQA soft accuracy by annotator agreement count (data_init.py:136-146)."""
    if occurences == 0:
        return 0.0
    if occurences == 1:
        return 0.3
    if occurences == 2:
        return 0.6
    if occurences == 3:
        return 0.9
    return 1.0


def filter_answers(
    answers_dset: Iterable[dict], dataset: str, min_occurence: int
) -> Dict[str, set]:
    """answer → set(question_ids), keeping answers seen in ≥ min_occurence questions."""
    occurence: Dict[str, set] = {}
    for ans_entry in answers_dset:
        if dataset == "vqa2.0":
            gtruths = [ans_entry["multiple_choice_answer"]]
        elif dataset == "okvqa":
            gtruths = list({a["answer"] for a in ans_entry["answers"]})
        else:
            raise ValueError(f"unknown dataset {dataset}")
        for gtruth in gtruths:
            gtruth = preprocess_answer(gtruth)
            occurence.setdefault(gtruth, set()).add(ans_entry["question_id"])
    return {a: q for a, q in occurence.items() if len(q) >= min_occurence}


def create_ans2label(
    answers_dset: Iterable[dict], dataset: str, min_occurence: int
) -> Tuple[Dict[str, int], List[str]]:
    occurence = filter_answers(answers_dset, dataset, min_occurence)
    label2ans = list(occurence.keys())
    ans2label = {a: i for i, a in enumerate(label2ans)}
    return ans2label, label2ans


def compute_soft_labels(
    answers: Sequence[dict], ans2label: Mapping[str, int]
) -> Dict[str, float]:
    """Per-question ``{answer: soft_score}`` label dict (data_init.py:255-326)."""
    counts = Counter(preprocess_answer(a["answer"]) for a in answers)
    return {a: get_score(c) for a, c in counts.items() if a in ans2label}


def compute_targets(
    answers_dset: Iterable[dict],
    ans2label: Mapping[str, int],
    id2question: Mapping[str, str],
) -> List[dict]:
    """Build the cache-file schema the reader pipeline consumes
    ({answer_type,img_id,label,question_id,question_type,sent})."""
    target = []
    for ans_entry in answers_dset:
        labels = compute_soft_labels(ans_entry["answers"], ans2label)
        target.append({
            "answer_type": ans_entry["answer_type"],
            "img_id": ans_entry["image_id"],
            "label": labels,
            "question_id": ans_entry["question_id"],
            "question_type": ans_entry["question_type"],
            "sent": id2question[str(ans_entry["question_id"])],
        })
    return target
